"""Deterministic random streams as explicit ``torch.Generator``s.

The JAX package folds one key: scene for frame f = fold(fold(seed, 1),
f // cadence), frame randomness = fold(fold(seed, 2), f). Here the same
(seed, stream, index) triples seed CPU generators through a splitmix64
mix, so any frame's scene, camera and light regenerate identically in
isolation, whatever batch the frame falls in. The streams differ from
``jax.random``'s: tests hand both packages the same sampled numbers.
"""

from __future__ import annotations

import torch

SCENE_STREAM = 1
FRAME_STREAM = 2
# What the JAX package draws from a key of its own (the ladder, from the
# pipeline seed), a key split off the frame's (the camera-mix coin) or one
# folded per frame (the training augment) has a stream of its own here, so
# the scene, camera and light draws stay as they were.
MIX_STREAM = 3
AUGMENT_STREAM = 4
LADDER_STREAM = 5
# Sequence mode: a clip's endpoint scenes, camera flight and light, each
# from a generator of its own per (seed, clip), where the JAX package folds
# 7771, 7772 and 7773 into fold(seed, clip).
SEQUENCE_STREAM = 7
CLIP_ENDPOINTS, CLIP_CAMERA, CLIP_LIGHT = 7771, 7772, 7773

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix(*words: int) -> int:
    """A 64-bit seed from a sequence of integers."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def generator(*words: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(mix(*words))
    return g


def scene_generator(seed: int, frame_id: int, cadence: int) -> torch.Generator:
    """The scene stream of the group holding ``frame_id``."""
    return generator(seed, SCENE_STREAM, int(frame_id) // cadence)


def frame_generator(seed: int, frame_id: int) -> torch.Generator:
    """The per-frame stream (camera, then lighting)."""
    return generator(seed, FRAME_STREAM, int(frame_id))


def mix_generator(seed: int, frame_id: int) -> torch.Generator:
    """The camera-mix coin of a training frame."""
    return generator(seed, MIX_STREAM, int(frame_id))


def augment_generators(seed: int, frame_id: int, device="cpu"):
    """The photometric augment of a training frame: a CPU generator for its
    scalars and one on ``device`` (the card's own, where it runs) for its
    noise image, from two words of the same frame."""
    noise = torch.Generator(device=device)
    noise.manual_seed(mix(seed, AUGMENT_STREAM, int(frame_id), 1))
    return generator(seed, AUGMENT_STREAM, int(frame_id), 0), noise


def clip_generator(seed: int, clip: int, purpose: int) -> torch.Generator:
    """The stream of one clip's ``purpose`` (``CLIP_ENDPOINTS``,
    ``CLIP_CAMERA`` or ``CLIP_LIGHT``)."""
    return generator(seed, SEQUENCE_STREAM, int(clip), int(purpose))
