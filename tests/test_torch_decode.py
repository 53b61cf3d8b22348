"""The port's decoding (``ops/decode.py``) and the peak kernel's plain
version (``ops/peak_kernel.extract_peaks_plain``) against the JAX package,
on the same numpy inputs.

Tolerances: soft-argmax, DARK and association to 1e-5 (f32 on both sides;
the logs come from two libraries). The peaks are compared as score-
thresholded sets per map, as ``tests/test_ops.py`` compares the JAX
package's two peak paths, because equal scores may come in another order
and the XLA path keeps the top-K of 2x2-block maxima whose two lowest
mantissa bits carry the position: scores to 2^-20 relative, uv to 1e-4
px. Against the Pallas kernel (interpret mode) scores are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.ops import decode as jdecode
from constructionsceneposeestimation_tpu.ops import heatmap as jheatmap
from constructionsceneposeestimation_tpu.ops import peak_kernel as jpeak
from constructionsceneposeestimation_tpu_torch.ops import decode, peak_kernel

torch.set_num_threads(2)


def _ops_maps():
    """The inputs of tests/test_ops.py::test_extract_peaks_pallas_matches_xla:
    (3, 5, 64, 128) blobs at three amplitudes plus noise with negatives."""
    rng = np.random.RandomState(3)
    n, C, H, W = 3, 5, 64, 128
    uv = jnp.asarray(rng.uniform(0, 500, (n * C // 2, 2)).astype(np.float32))
    ch = jnp.asarray(rng.randint(0, C, len(uv)), jnp.int32)
    base = jheatmap.render_heatmaps(uv, ch, jnp.ones(len(uv), bool), C, H, W, 2.0, stride=4.0)
    hms = jnp.stack([base * s for s in (1.0, 0.7, 0.4)])
    return np.array(hms + 0.02 * jnp.asarray(rng.randn(*hms.shape).astype(np.float32)))


def _clean_maps():
    """The inputs of test_extract_peaks_pallas_padding_and_leading_dims."""
    uv = jnp.asarray([[20.3, 10.6], [50.8, 25.2]])
    return np.array(jheatmap.render_heatmaps(uv, jnp.asarray([0, 0], jnp.int32),
                                               jnp.asarray([True, True]), 3, 40, 128, sigma=2.0))


def _assert_same_sets(uv_a, sc_a, uv_b, sc_b, thresh, rtol_score, atol_uv):
    uv_a, sc_a = np.asarray(uv_a).reshape(-1, sc_a.shape[-1], 2), np.asarray(sc_a)
    uv_b, sc_b = np.asarray(uv_b).reshape(-1, sc_b.shape[-1], 2), np.asarray(sc_b)
    sc_a, sc_b = sc_a.reshape(len(uv_a), -1), sc_b.reshape(len(uv_b), -1)
    for m in range(len(uv_a)):
        a = [(s, u) for s, u in zip(sc_a[m], uv_a[m]) if s > thresh]
        b = [(s, u) for s, u in zip(sc_b[m], uv_b[m]) if s > thresh]
        assert len(a) == len(b), (m, a, b)
        for s, u in a:
            hit = [j for j, (s2, u2) in enumerate(b)
                   if abs(s - s2) <= rtol_score * s and np.abs(u - u2).max() <= atol_uv]
            assert hit, (m, s, u, b)
            b.pop(hit[0])


def test_extract_peaks_plain_matches_xla_and_pallas():
    hms = _ops_maps()
    uv, sc = decode.extract_peaks(torch.as_tensor(hms), 6)
    assert uv.shape == (3, 5, 6, 2) and sc.shape == (3, 5, 6)
    uv_x, sc_x = jdecode.extract_peaks(jnp.asarray(hms), max_peaks=6, use_pallas=False)
    uv_p, sc_p = jpeak.extract_peaks_pallas(jnp.asarray(hms), max_peaks=6, interpret=True)
    _assert_same_sets(uv, sc, uv_x, sc_x, 0.05, 2 ** -20, 1e-4)
    _assert_same_sets(uv, sc, uv_p, sc_p, 0.05, 0.0, 1e-4)
    # Scores come out sorted, as the raw (relu'd) amplitude.
    s = sc.numpy()
    assert (np.diff(s, axis=-1) <= 0).all() and (s >= 0).all()


def test_extract_peaks_plain_leading_dims_and_padding():
    hm = _clean_maps()  # (3, 40, 128): one channel with two blobs, two empty
    pk, sc = peak_kernel.extract_peaks_plain(torch.as_tensor(hm), max_peaks=4)
    assert pk.shape == (3, 4, 2) and sc.shape == (3, 4)
    uv_p, sc_p = jpeak.extract_peaks_pallas(jnp.asarray(hm), max_peaks=4, block_maps=8,
                                            interpret=True)
    _assert_same_sets(pk, sc, uv_p, sc_p, 0.0, 0.0, 1e-4)
    strong = pk[0].numpy()[sc[0].numpy() > 0.5]
    d = np.linalg.norm(strong[:, None] - np.asarray([[20.3, 10.6], [50.8, 25.2]])[None], axis=-1)
    assert d.min(axis=0).max() < 0.15
    # Fewer positive peaks than K: the rounds repeat pixel (0, 0) at score 0.
    np.testing.assert_array_equal(sc[0, 2:].numpy(), 0.0)
    np.testing.assert_array_equal(pk[0, 2:].numpy(), 0.0)
    np.testing.assert_array_equal(sc[1:].numpy(), 0.0)
    np.testing.assert_array_equal(pk[1:].numpy(), 0.0)


def test_extract_peaks_plain_selection_rule():
    """Equal values: the lowest row, then the lowest column; K rounds of
    suppress-to-0, so a taken peak is never taken twice; 3x3 maps and odd
    shapes; blur off."""
    x = torch.zeros(1, 9, 11)
    for r, c in ((6, 2), (2, 8), (2, 3), (6, 8)):
        x[0, r, c] = 1.0
    x[0, 4, 5] = 2.0
    uv, sc = peak_kernel.extract_peaks_plain(x, max_peaks=6)
    assert sc[0].tolist() == [2.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    assert uv[0].round().tolist() == [[5, 4], [3, 2], [8, 2], [2, 6], [8, 6], [0, 0]]
    tiny = torch.tensor([[[0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [3.0, 0.0, 0.0]]])
    uv, sc = peak_kernel.extract_peaks_plain(tiny, max_peaks=3, blur=False)
    assert sc[0].tolist() == [3.0, 1.0, 0.0] and uv[0].tolist() == [[0, 2], [1, 0], [0, 0]]
    rng = np.random.RandomState(0)
    # Maps of no aligned width (the XLA path needs even H and W).
    noisy = rng.rand(3, 5, 38, 62).astype(np.float32) - 0.3
    uv, sc = peak_kernel.extract_peaks_plain(torch.as_tensor(noisy), 8)
    uv_x, sc_x = jdecode.extract_peaks(jnp.asarray(noisy), max_peaks=8, use_pallas=False)
    _assert_same_sets(uv, sc, uv_x, sc_x, 0.0, 2 ** -20, 1e-4)
    uv, sc = peak_kernel.extract_peaks_plain(torch.as_tensor(noisy[..., :37, :61]), 8)
    assert uv.shape == (3, 5, 8, 2) and (sc[..., -1] > 0).all()


def _adversarial_maps(kind):
    """The peak kernel's hard inputs, at even H and W (the JAX XLA path's
    2x2 blocks): every pixel a survivor, flat-topped blobs, nothing
    positive, and one 192 x 256 map."""
    rng = np.random.RandomState(len(kind))
    shape = (2, 3, 32, 48)
    if kind == "constant":
        return np.full(shape, 0.75, np.float32)
    if kind == "all_negative":
        return -rng.rand(*shape).astype(np.float32) - 0.01
    if kind == "all_zero":
        return np.zeros(shape, np.float32)
    if kind == "plateau":  # blobs clipped to 1.0: ~100 equal pixels a top
        yy, xx = np.mgrid[:32, :48]
        x = np.zeros(shape, np.float32)
        for idx in np.ndindex(shape[:2]):
            for _ in range(3):
                cy, cx = rng.uniform(4, 28), rng.uniform(4, 44)
                x[idx] += 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 32.0)
        return np.minimum(x, 1.0)
    yy, xx = np.mgrid[:192, :256]  # "192x256": blobs, noise with negatives
    x = 0.05 * rng.randn(1, 1, 192, 256).astype(np.float32)
    for _ in range(12):
        cy, cx = rng.uniform(0, 192), rng.uniform(0, 256)
        x[0, 0] += rng.uniform(0.3, 1.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    return x


@pytest.mark.parametrize("kind", ["constant", "plateau", "all_negative", "all_zero", "192x256"])
def test_extract_peaks_plain_adversarial_maps_match_xla(kind):
    """The plain version against the JAX XLA path on the inputs the card
    holds the kernel to. On constant and plateau maps many equal values
    survive NMS and the XLA path breaks their ties by 2x2 block (dropping
    tied duplicates) rather than by flat index, so there the sorted scores
    are compared; elsewhere the score-thresholded sets, as
    ``_assert_same_sets`` does."""
    hms = _adversarial_maps(kind)
    uv, sc = peak_kernel.extract_peaks_plain(torch.as_tensor(hms), 8)
    uv_x, sc_x = jdecode.extract_peaks(jnp.asarray(hms), max_peaks=8, use_pallas=False)
    s = sc.numpy()
    assert (np.diff(s, axis=-1) <= 0).all() and (s >= 0).all()
    if kind in ("constant", "plateau"):
        np.testing.assert_allclose(s, -np.sort(-np.asarray(sc_x), -1), rtol=2 ** -20, atol=0)
        assert (s[..., -1] > 0).all()
    else:
        _assert_same_sets(uv, sc, uv_x, sc_x, 0.0, 2 ** -20, 1e-4)
    if kind == "constant":  # every pixel survives: the first 8 of row 0
        np.testing.assert_array_equal(uv.numpy(), np.broadcast_to(
            np.stack([np.arange(8), np.zeros(8)], -1), uv.shape))
    if kind in ("all_negative", "all_zero"):  # (0, 0) at score 0 throughout
        np.testing.assert_array_equal(s, 0.0)
        np.testing.assert_array_equal(uv.numpy(), 0.0)
    if kind == "192x256":
        assert (s[..., :8] > 0.2).all()


def test_peaks_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        peak_kernel.peaks_cuda(torch.zeros(2, 16, 16))


def test_dark_decode_and_soft_argmax_match_jax():
    hms = _ops_maps()[:, :, :32, :48]
    for blur in (True, False):
        uv, sc = decode.dark_decode(torch.as_tensor(hms), blur=blur)
        uv_j, sc_j = jdecode.dark_decode(jnp.asarray(hms), blur=blur)
        np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))
    for temp in (None, 10.0):
        uv, sc = decode.soft_argmax(torch.as_tensor(hms), temp)
        uv_j, sc_j = jdecode.soft_argmax(jnp.asarray(hms), temp)
        np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))
    # A peak on the border skips the refinement and stays finite.
    border = np.zeros((1, 1, 16, 16), np.float32)
    border[0, 0, 0, 0] = 1.0
    uv, _ = decode.dark_decode(torch.as_tensor(border))
    assert uv[0, 0].tolist() == [0.0, 0.0]


def test_neighborhoods_match_jax():
    rng = np.random.RandomState(1)
    hm = rng.rand(2, 3, 9, 13).astype(np.float32)
    py = rng.randint(-1, 10, (2, 3, 4)).astype(np.int32)
    px = rng.randint(-1, 14, (2, 3, 4)).astype(np.int32)
    got = decode._extract_neighborhoods(torch.as_tensor(hm), torch.as_tensor(py),
                                        torch.as_tensor(px))
    ref = jdecode._extract_neighborhoods(jnp.asarray(hm), jnp.asarray(py), jnp.asarray(px))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(decode._gaussian_blur_3x3(torch.as_tensor(hm)).numpy(),
                                  np.asarray(jdecode._gaussian_blur_3x3(jnp.asarray(hm))))


def test_associate_peaks_matches_jax():
    rng = np.random.RandomState(2)
    B, C, P, O, K = 2, 6, 5, 4, 3
    uv_pk = rng.uniform(0, 100, (B, C, P, 2)).astype(np.float32)
    sc_pk = rng.rand(B, C, P).astype(np.float32)
    channels = rng.randint(-1, C, (O, K)).astype(np.int32)
    lo = rng.randint(0, 60, (B, O, 2))
    bbox = np.concatenate([lo, lo + rng.randint(5, 40, (B, O, 2))], -1).astype(np.int32)
    bbox[0, 1] = -1  # an unseen instance
    got = decode.associate_peaks(torch.as_tensor(uv_pk), torch.as_tensor(sc_pk),
                                 torch.as_tensor(channels), torch.as_tensor(bbox))
    ref = jdecode.associate_peaks(jnp.asarray(uv_pk), jnp.asarray(sc_pk), jnp.asarray(channels),
                                  jnp.asarray(bbox))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    assert (got[1][0, 1] == 0).all()


def test_decode_keypoints_matches_jax():
    from constructionsceneposeestimation_tpu.models import pose_net as jpose_net
    from constructionsceneposeestimation_tpu_torch.models import pose_net

    hms = _ops_maps()[:2, :, :32, :32]
    for dark in (True, False):
        uv, sc = pose_net.decode_keypoints(torch.as_tensor(hms), 4.0, dark)
        uv_j, sc_j = jpose_net.decode_keypoints(jnp.asarray(hms), 4.0, dark)
        np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), atol=4e-5, rtol=0)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))
