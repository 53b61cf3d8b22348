"""The check that decides ``correct``, shown to fail: the reference agrees
with the port at 64^2 on the CPU; an output altered where it is produced,
a step that leaves its state unchanged and a loss over half the batch each
make a run come out not correct, and on several ranks so do gradients left
unaveraged and every rank training the same rows; so does the control, the
reference in the precision below the configuration's. On the card the
control runs at the cell's own size."""

import pytest
import torch

import perfbench_tiny as tiny
from harness import compare, faults, generate, manifest, training
from reference import training as ref_training

GENERATE = [n for n in tiny.cells() if "train" not in n]
TRAIN = [n for n in tiny.cells() if "train" in n]
SHARDED = [n for n in TRAIN if manifest.load_cell(n).chips > 1]


@pytest.mark.parametrize("name", GENERATE)
def test_reference_agrees_with_the_port(name):
    """The plain reference and the port on the same frames, on the CPU
    (where both take the plain paths): every number is 0."""
    cell = tiny.tiny(name)
    stream = generate.Stream(cell, torch.device("cpu"))
    sample = generate.Sample(tiny.SEED, 3, stream.B)
    for _ in range(2):
        stream.batch(tiny.SEED, sample.offer)
    prog = sample.batch_of()
    ref, lo, hi = generate.reference_frames(cell, tiny.SEED, prog.frame_id.tolist(),
                                            torch.device("cpu"), noise_ends=True)
    assert all(v == 0.0 for v in compare.frame_numbers(prog, ref, (lo, hi)).values())


def _render_altered(field, change):
    """The port's ``Pipeline.render`` with one output field altered."""
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    def wrap(fn):
        def render(self, *a, **kw):
            b = fn(self, *a, **kw)
            return b._replace(**{field: change(getattr(b, field))})
        return render
    return faults.patched(Pipeline, "render", wrap)


ALTERED = {"depth": lambda x: x * 1.01, "instance": lambda x: torch.where(x >= 0, x + 1, x),
           "kpt_uv": lambda x: x + 0.5, "heatmaps": lambda x: x * 0.5,
           "rgb": lambda x: 255 - x, "inst_pixel_count": lambda x: x + 5,
           "center": lambda x: x + 0.01}


@pytest.mark.parametrize("field", sorted(ALTERED))
@pytest.mark.parametrize("name", GENERATE[:1])
def test_altered_output_is_not_correct(name, field):
    cell = tiny.tiny(name)
    with _render_altered(field, ALTERED[field]):
        result, checks = tiny.run(cell)
    assert not result["correct"], (field, checks)


def _one_instance_shaded(levels: int):
    """The port's ``Pipeline.render`` with one instance's RGB in each
    frame, its smallest of a twentieth of the frame or more, moved by
    ``levels``: a local fault of the shading, which a mean over the frames
    dilutes."""
    def change(b):
        rgb = b.rgb.clone()
        moved = (b.rgb.to(torch.int16) + levels).clamp(0, 255).to(torch.uint8)
        for f, inst in enumerate(b.instance):
            ids, counts = torch.unique(inst[inst >= 0], return_counts=True)
            big = counts >= inst.numel() // 20
            if bool(big.any()):
                k = ids[big][counts[big].argmin()]
                rgb[f] = torch.where((inst == k)[..., None], moved[f], b.rgb[f])
        return b._replace(rgb=rgb)

    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    def wrap(fn):
        return lambda self, *a, **kw: change(fn(self, *a, **kw))
    return faults.patched(Pipeline, "render", wrap)


def _window_of(batches: int):
    """The measured window as ``batches`` batches, however fast the CPU is,
    so that the frames drawn for the check are the same in every run."""
    from harness import window

    def wrap(fn):
        def run(w, seconds, step):
            w.start()
            for i in range(batches):
                step(i)
                w.mark()
            return w.finish()
        return run
    return faults.patched(window, "run", wrap)


@pytest.mark.parametrize("name", GENERATE[:1])
def test_local_rgb_fault_is_not_correct(name):
    """One instance's shading off by 20 levels passes the mean gap over the
    frames and fails the share of pixels beyond the noise's ends. At 64^2
    many frames hold no instance of a twentieth of the frame, which the
    fault leaves as they are, so the window is fixed at 8 batches, whose
    draw holds such an instance."""
    cell = tiny.tiny(name)
    with _one_instance_shaded(20), _window_of(8):
        result, checks = tiny.run(cell)
    assert not result["correct"], checks
    assert checks["rgb_mean_gap"]["value"] <= checks["rgb_mean_gap"]["limit"], checks
    assert checks["rgb_beyond_noise"]["value"] > checks["rgb_beyond_noise"]["limit"], checks


@pytest.mark.parametrize("name", GENERATE)
def test_reference_lies_between_its_noise_ends(name):
    """Whatever the hash noise reads, the reference's own RGB lies between
    its images with the noise at either end (``reference/noise``)."""
    cell = tiny.tiny(name)
    ids = list(range(cell.mix["batch"]))
    ref, lo, hi = generate.reference_frames(cell, tiny.SEED, ids, torch.device("cpu"),
                                            noise_ends=True)
    assert lo.shape == hi.shape == ref.rgb.shape
    assert bool((lo <= ref.rgb).all()) and bool((ref.rgb <= hi).all())
    assert bool((lo < hi).any())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "rgb_altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_training_fault_is_not_correct(name, fault):
    """Each fault planted in the port on every rank (``harness/faults``)."""
    cell = tiny.tiny(name)
    result, checks = tiny.run(cell, plant=faults.FAULTS[fault])
    assert not result["correct"], (fault, checks)


@pytest.mark.parametrize("fault", ["no_sync", "one_shard"])
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_fault_is_not_correct(name, fault):
    """On two gloo ranks: the gradients not averaged over the ranks fail
    the gradient's numbers; every rank training rank 0's rows fails the
    batch's."""
    cell = tiny.tiny(name)
    result, checks = tiny.run(cell, plant=faults.FAULTS[fault])
    assert not result["correct"], (fault, checks)
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    want = {"no_sync": {"grad_gap", "grad_diff"},
            "one_shard": {"batch_rgb_frame_gap", "batch_heatmap_gap"}}[fault]
    assert failed & want, (fault, checks)


def _generate_control(cell, device):
    stream = generate.Stream(cell, device)
    sample = generate.Sample(tiny.SEED, cell.mix["check_frames"], stream.B)
    for _ in range(2):
        stream.batch(tiny.SEED, sample.offer)
    ids = sample.batch_of().frame_id.tolist()
    ref, lo, hi = generate.reference_frames(cell, tiny.SEED, ids, device, noise_ends=True)
    ctl = generate.reference_frames(cell, tiny.SEED, ids, device, control=True)
    return compare.judge(compare.frame_numbers(ctl, ref, (lo, hi)), cell.limits)


def _training_control(cell, device):
    ids = [list(range(i * cell.mix["batch"], (i + 1) * cell.mix["batch"]))
           for i in range(cell.mix["check_steps"])]
    ref = ref_training.steps(cell, tiny.SEED, ids, device)
    ctl = ref_training.steps(cell, tiny.SEED, ids, device, control=True)
    return compare.judge(training.train_numbers(ctl, ref), cell.limits)


@pytest.mark.parametrize("name", tiny.cells())
def test_control_is_not_correct(name):
    """The control put in the program's place, at 64^2 on the CPU."""
    cell = tiny.tiny(name)
    fn = _training_control if "train" in name else _generate_control
    correct, checks = fn(cell, torch.device("cpu"))
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7, 9876543211])
@pytest.mark.parametrize("name", tiny.cells())
def test_control_is_not_correct_on_the_card(name, seed):
    """The control at the cell's own size on the card, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = manifest.load_cell(name)
    tiny.SEED, saved = seed, tiny.SEED
    try:
        fn = _training_control if "train" in name else _generate_control
        correct, checks = fn(cell, torch.device("cuda", 0))
    finally:
        tiny.SEED = saved
    assert not correct, checks
