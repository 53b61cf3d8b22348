"""The replayed draws (``sample/replay.py``, ``csrc/draws.cu``).

On the CPU: a plain numpy MT19937 that follows the kernel's plan (the stream
keys, the three twist ranges, the word layout the kernel is given, the
randperm's swaps) equals the CPU generators the host path draws from, for
scene groups under the default config and its variants, frames and
camera-mix coins, at seeds and ids beyond 32 bits.

On the card (marked ``cuda``; they import no JAX, so run them without the
suite's conftest, ``python -m pytest --noconftest -m cuda
tests/test_torch_draws.py``): the kernel's tensors equal the host loop's
bit for bit, and a CUDA pipeline's inputs equal those of the same pipeline
fed the host's draws."""

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                              RandomizationConfig, SceneConfig)
from constructionsceneposeestimation_tpu_torch.parallel import pipeline
from constructionsceneposeestimation_tpu_torch.sample import camera_sampler, lighting, replay
from constructionsceneposeestimation_tpu_torch.utils import prng

torch.set_num_threads(2)
N, M = 624, 397
SEEDS = [0, 2**31 + 5, 2**40 + 7]
U32 = np.uint32


def _stream_seed(seed, stream, index):
    """The kernel's seed: the host's key prng.mix(seed, stream), one more
    splitmix64 fold of the index, its low 32 bits."""
    key = prng.mix(seed, stream)
    return prng._splitmix64(key ^ (int(index) & ((1 << 64) - 1))) & 0xFFFFFFFF


def _twist(u, v):
    y = (u & U32(0x80000000)) | (v & U32(0x7FFFFFFF))
    return (y >> U32(1)) ^ np.where(v & U32(1), U32(0x9908B0DF), U32(0))


def _temper(y):
    y = y ^ (y >> U32(11))
    y = y ^ ((y << U32(7)) & U32(0x9D2C5680))
    y = y ^ ((y << U32(15)) & U32(0xEFC60000))
    return y ^ (y >> U32(18))


def mt_words(seed32, n):
    """The first ``n`` words of MT19937 seeded with ``seed32``, twisted in
    the kernel's three ranges: 0-226 on the old state, 227-453 and 454-623
    on the words the range before made."""
    s, x = np.empty(N, U32), seed32
    for j in range(N):
        s[j] = x
        x = (1812433253 * (x ^ (x >> 30)) + j + 1) & 0xFFFFFFFF
    out = []
    while len(out) * N < n:
        for lo, hi in ((0, N - M), (N - M, 2 * (N - M)), (2 * (N - M), N)):
            i = np.arange(lo, hi)
            far = s[np.where(i < N - M, i + M, i - (N - M))]
            s[lo:hi] = far ^ _twist(s[i], s[(i + 1) % N])
        out.append(_temper(s.copy()))
    return np.concatenate(out)[:n]


def _unit(words):
    return torch.from_numpy((words & U32(0xFFFFFF)).astype(np.float32) * np.float32(2.0**-24))


def plan_scene_draws(layout, seed, groups):
    """The (G, ...) scene tensors as the kernel writes them: each group's
    words placed by the layout's table, key by key."""
    G = len(groups)
    out = torch.zeros(G * layout.floats)
    for g, grp in enumerate(groups):
        words = mt_words(_stream_seed(seed, prng.SCENE_STREAM, grp), layout.words)
        for first, n, key_off, key_size, j0, perm in layout.table:
            at = key_off * G + g * key_size + j0
            w = words[first:first + n]
            if perm:
                r = list(range(perm))
                for i in range(perm - 1):
                    z = int(w[i]) % (perm - i)
                    r[i], r[i + z] = r[i + z], r[i]
                out[at:at + perm] = torch.tensor(r, dtype=torch.float32)
            else:
                out[at:at + n] = _unit(w)
    draws, at = {}, 0
    for k, shape in layout.keys:
        size = G * int(np.prod(shape))
        draws[k] = out[at:at + size].view(G, *shape)
        at += size
    return draws


SCENES = {"default": (SceneConfig(), RandomizationConfig()),
          "no_dumpers": (SceneConfig(n_dumpers=0), RandomizationConfig()),
          "two_dumpers": (SceneConfig(n_dumpers=2), RandomizationConfig()),
          "no_cones": (SceneConfig(n_cones=0), RandomizationConfig()),
          "attempts_17": (SceneConfig(), RandomizationConfig(max_attempts=17))}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_scene_streams_follow_the_layout(scene, seed):
    scfg, rcfg = SCENES[scene]
    layout = replay.word_layout(scfg, rcfg)
    groups = [0, 7, 10**6 + 1]
    host = replay.host_draws(seed, [0], groups, 10, scfg, rcfg, coins=False)
    plan = plan_scene_draws(layout, seed, groups)
    assert list(plan) == [k for k in host if k != "frame"]
    for k, v in plan.items():
        assert v.dtype == host[k].dtype and torch.equal(v, host[k]), k


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_streams_take_twelve_words(seed):
    fids = [0, 1, 12345, 10**7]
    host = replay.host_draws(seed, fids, [0], 10, SceneConfig(), RandomizationConfig(),
                             coins=False)["frame"]
    plan = torch.stack([_unit(mt_words(_stream_seed(seed, prng.FRAME_STREAM, f),
                                       replay.FRAME_WORDS)) for f in fids])
    assert torch.equal(plan, host)


@pytest.mark.parametrize("seed", SEEDS)
def test_coin_streams_take_one_word(seed):
    fids = [3, 999, 10**7 - 1]
    host = replay.host_draws(seed, fids, [0], 10, SceneConfig(), RandomizationConfig(),
                             coins=True)["coin"]
    plan = torch.cat([_unit(mt_words(_stream_seed(seed, prng.MIX_STREAM, f), 1)) for f in fids])
    assert torch.equal(plan, host)


def test_word_layout_of_the_default_config():
    layout = replay.word_layout()
    assert replay.FRAME_WORDS == camera_sampler.CAMERA_DRAWS + lighting.LIGHTING_DRAWS
    # crane 165, one dumper's permutation (6 words, 7 floats) and its 1297
    # other words, a human's 175, eight cones' 1320
    assert (layout.words, layout.floats) == (2963, 2964)
    starts = [row[0] for row in layout.table]
    assert starts[0] == 0 and starts == sorted(set(starts))
    assert starts[-1] + layout.table[-1][1] == layout.words
    assert [row for row in layout.table if row[5]] == [(165, 6, 165, 7, 0, 7)]


def test_word_layout_refuses_what_the_kernel_cannot_hold():
    # one segment a key and one more a dumper: 15 + 60 rows, over 64
    with pytest.raises(ValueError, match="segments"):
        replay.word_layout(SceneConfig(n_dumpers=60))
    assert len(replay.word_layout(SceneConfig(n_dumpers=49)).table) == replay.MAX_SEGMENTS


def test_cpu_pipeline_returns_its_frame_ids():
    cfg = Config(scene=SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
                 pipeline=PipelineConfig(render_width=32, render_height=32))
    inputs = pipeline.Pipeline(cfg, device="cpu").sample_inputs(3, [4, 15, 16])
    assert inputs.frame_id.dtype == torch.int32 and inputs.frame_id.tolist() == [4, 15, 16]
    assert inputs.cam_pos.shape == (3, 3)


# On the card.

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _ids(fids, cadence, layout, dev):
    groups = sorted({f // cadence for f in fids})
    table = [v for row in layout.table for v in row]
    ids = torch.tensor(table + fids + groups, dtype=torch.int32, device=dev)
    return groups, ids.split([len(table), len(fids), len(groups)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 10**6 + 3])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("coins", [False, True])
def test_kernel_equals_the_host_loop(dev, seed, offset, coins):
    scfg, rcfg = SceneConfig(), RandomizationConfig()
    layout = replay.word_layout(scfg, rcfg)
    fids = list(range(offset, offset + 512))
    groups, (table, frame_id, group_id) = _ids(fids, 10, layout, dev)
    before = replay.replay_cuda.launches
    out = replay.replay_cuda(layout, seed, table, frame_id, group_id, coins)
    torch.cuda.synchronize()
    assert replay.replay_cuda.launches == before + 1
    host = replay.host_draws(seed, fids, groups, 10, scfg, rcfg, coins)
    assert list(out) == list(host)
    for k, v in host.items():
        assert out[k].shape == v.shape and torch.equal(out[k].cpu(), v), k


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["no_dumpers", "two_dumpers", "no_cones", "attempts_17"])
def test_kernel_follows_other_layouts(dev, scene):
    scfg, rcfg = SCENES[scene]
    layout = replay.word_layout(scfg, rcfg)
    fids = [5, 17, 10**7]
    groups, (table, frame_id, group_id) = _ids(fids, 10, layout, dev)
    out = replay.replay_cuda(layout, SEEDS[1], table, frame_id, group_id, True)
    host = replay.host_draws(SEEDS[1], fids, groups, 10, scfg, rcfg, True)
    for k, v in host.items():
        assert torch.equal(out[k].cpu(), v), k


def _small_cfg():
    return Config(scene=SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
                  pipeline=PipelineConfig(render_width=64, render_height=64))


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [None, 0.3], ids=["ladder", "camera_mix"])
def test_card_inputs_equal_those_of_the_host_draws(dev, mix):
    """The train step's 32 frames (camera mix 0.3) and a ladder batch: the
    replayed pipeline's inputs equal, field by field, those of the same
    card pipeline fed the host loop's draws."""
    pipe = pipeline.Pipeline(Config(), device=dev)
    fed = pipeline.Pipeline(Config(), device=dev)
    fed._replayed_draws = fed._host_draws
    fids = list(range(3205, 3237))
    ladder = pipe.ladder()
    a = pipe.sample_inputs(SEEDS[2], fids, ladder, mix)
    b = fed.sample_inputs(SEEDS[2], fids, ladder, mix)
    flat = lambda x: [v for f in x for v in (flat(f) if isinstance(f, tuple) else [f])]
    for u, v in zip(flat(a), flat(b)):
        assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.cuda
def test_generate_launches_the_kernel_once_a_batch(dev):
    pipe = pipeline.Pipeline(_small_cfg(), device=dev)
    gen = pipe.make_generate_fn(camera_mix=0.3)
    before = replay.replay_cuda.launches
    for b in range(3):
        fb = gen(11, range(b * 8, b * 8 + 8))
        assert fb.frame_id.is_cuda and fb.frame_id.tolist() == list(range(b * 8, b * 8 + 8))
    assert replay.replay_cuda.launches == before + 3
