"""The port's ``bench`` command (``constructionsceneposeestimation_tpu_torch/
bench.py``) on the CPU at 64^2: the JSON line of the JAX ``bench.py``, the
consumer against the JAX formula on the same frames, the chain's seeds and
frame ids, the ``bench`` subcommand, and the refusal without a card. The
card's run at 4 x 512 frames of 512^2 is ``chip_smoke.py``'s ``[bench]``
phase."""

import functools
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from constructionsceneposeestimation_tpu_torch import bench, cli
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
from constructionsceneposeestimation_tpu_torch.parallel import pipeline as pipeline_mod

torch.set_num_threads(2)
SMALL = dict(batch=2, steps=1, size=64)
KEYS = ["metric", "value", "unit", "vs_baseline"]


def _line(out: str) -> dict:
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert list(rec) == KEYS
    assert rec["metric"] == "annotated_512x512_frames_per_sec_per_chip"
    assert rec["unit"] == "frames/s"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 0.15, 1)
    return rec


def test_constants_are_jax_bench():
    # bench.py:27-29 of the repository root.
    assert (bench.REFERENCE_FPS, bench.BATCH, bench.STEPS, bench.SIZE) == (0.15, 512, 4, 512)


def test_main_prints_one_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, **SMALL))
    res = bench.main(device="cpu")
    rec = _line(capsys.readouterr().out)
    assert rec["value"] == round(res["fps"], 2)
    assert res["fps"] == pytest.approx(2 / (res["ms"] / 1000.0))
    assert res["peak_bytes"] is None and res["ms"] == res["host_ms"] > 0
    assert math.isfinite(res["total"]) and res["total"] > 1.0


def test_cli_bench(capsys, monkeypatch):
    args = cli.build_parser().parse_args(["bench"])
    assert args.device == "cuda" and args.fn is cli.cmd_bench
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, **SMALL))
    cli.main(["bench", "--device", "cpu"])
    _line(capsys.readouterr().out)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.run()


def test_chain_seeds_and_frame_ids(monkeypatch):
    calls = []
    make = pipeline_mod.Pipeline.make_generate_fn

    def recording(self, **kw):
        assert kw == {"ladder": False}
        gen = make(self, **kw)

        def wrapped(seed, ids):
            calls.append((seed, list(ids)))
            return gen(seed, ids)
        return wrapped

    monkeypatch.setattr(pipeline_mod.Pipeline, "make_generate_fn", recording)
    bench.run(batch=2, steps=2, size=64, device="cpu")
    # A warm-up chain of 2 steps, then 2 timed steps with seeds of their own.
    assert calls == [(0, [0, 1]), (1, [0, 1]), (2, [0, 1]), (3, [0, 1])]


def _jax_consume(b):
    """The JAX benchmark's consumer (the repository root's bench.py:56-64),
    restated: it is a closure inside ``main`` there and cannot be
    imported."""
    f32 = jnp.float32
    fin = lambda x: jnp.sum(jnp.where(jnp.isfinite(x), x, 0.0))
    return (fin(b.depth) + jnp.sum(b.rgb.astype(f32))
            + jnp.sum(b.instance).astype(f32) + jnp.sum(b.heatmaps)
            + fin(b.kpt_uv) + jnp.sum(b.kpt_visible).astype(f32)
            + jnp.sum(b.kpt_in_image).astype(f32)
            + fin(b.center) + fin(b.size) + fin(b.euler_deg)
            + jnp.sum(b.bbox2d).astype(f32) + fin(b.camera_pose7)
            + jnp.sum(b.inst_pixel_count).astype(f32)
            + jnp.sum(b.pointcloud_count).astype(f32))


@pytest.fixture(scope="module")
def frames():
    cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=64, batch_size=2))
    return pipeline_mod.Pipeline(cfg, device="cpu").make_generate_fn()(3, range(2))


@pytest.mark.parametrize("poison", ["none", "nan_center", "inf_kpt_uv"])
def test_consume_matches_jax_formula(frames, poison):
    fb = frames
    if poison == "nan_center":
        fb = fb._replace(center=fb.center.clone().index_fill_(1, torch.tensor([0]), math.nan))
    elif poison == "inf_kpt_uv":
        fb = fb._replace(kpt_uv=fb.kpt_uv.clone().index_fill_(2, torch.tensor([1]), -math.inf))
    assert bool(torch.isinf(fb.depth).any())  # sky pixels: counted as 0
    mine = bench.consume(fb)
    assert mine.dtype == torch.float32 and mine.shape == ()
    ref = _jax_consume(pipeline_mod.FrameBatch(*(jnp.asarray(v.numpy()) for v in fb)))
    assert math.isfinite(float(mine))
    np.testing.assert_allclose(float(mine), float(ref), rtol=1e-5)
    # The two fields JAX leaves out do not move the total.
    for name in ("frame_id", "inst_visible"):
        v = getattr(fb, name)
        other = fb._replace(**{name: torch.zeros_like(v)})
        assert float(bench.consume(other)) == float(mine)
