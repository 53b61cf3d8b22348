"""Every uniform of an i.i.d. batch, drawn on the card by replaying the host's
CPU generator streams bit for bit (``csrc/draws.cu``).

The host path (``host_draws``, the plain version) draws a batch from one CPU
``torch.Generator`` a scene group, a frame and a camera-mix coin
(``utils/prng``): ``placement.scene_draws``, ``camera_draws`` then
``lighting_draws``, one ``torch.rand`` of ``MIX_STREAM``. Each generator is
MT19937 seeded with the low 32 bits of ``prng.mix(seed, stream, index)``; a
float32 of ``torch.rand`` is one 32-bit word w, (w & 0xFFFFFF) * 2^-24, and
``torch.randperm(n)`` takes n - 1 words. So every uniform follows from
(seed, stream, index, word), and the kernel makes them with no host loop:
``WordLayout`` tells it where each word of a scene stream lands in
``placement.stack_draws``' tensors. ``replay_cuda`` launches it and counts
its launches and streams (``replay_cuda.launches``, ``.streams``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch

from ..config import RandomizationConfig, SceneConfig
from ..utils import kernels, prng
from . import camera_sampler, lighting, placement

Tensor = torch.Tensor

# Words a frame stream gives: the camera's, then the light's
# (csrc/draws.cu's kFrameWords).
FRAME_WORDS = 12
# ``scene_draws`` keys drawn as rows of ``torch.randperm(n)``, stored as float.
PERM_KEYS = {"dumper_perm": placement._N_AREAS}
MAX_PERM = 8  # the largest n the kernel permutes
MAX_SEGMENTS = 64  # the most segments the kernel's table holds
SEG_COLS = 6  # a segment: first word, words, key offset, key size, offset in the key, n or 0


@dataclasses.dataclass(frozen=True)
class WordLayout:
    """Where each word of a scene group's stream lands: ``keys`` are
    ``scene_draws``' (name, shape) in its order, each a (G, *shape) block of
    the kernel's output; ``table`` a segment a row (``SEG_COLS`` ints: the
    segment's first word, its words, its key's offset and size in floats a
    group, its offset in the key, the n of a randperm or 0 for floats);
    ``words`` a stream's words, ``floats`` a group's floats."""

    keys: tuple
    table: tuple
    words: int
    floats: int


def word_layout(scene_cfg: SceneConfig = SceneConfig(),
                cfg: RandomizationConfig = RandomizationConfig()) -> WordLayout:
    """The layout of ``placement.scene_draws`` under these configs, read from
    one call of it: its keys, their order and shapes."""
    shapes = {k: tuple(v.shape)
              for k, v in placement.scene_draws(torch.Generator(), scene_cfg, cfg).items()}
    rows, word, off = [], 0, 0
    for k, shape in shapes.items():
        size = math.prod(shape)
        n = PERM_KEYS.get(k, 0)
        if n > MAX_PERM:
            raise ValueError(f"draws: {k} permutes {n} areas, the kernel at most {MAX_PERM}")
        if n:
            for r in range(shape[0]):
                rows.append((word, n - 1, off, size, r * n, n))
                word += n - 1
        elif size:
            rows.append((word, size, off, size, 0, 0))
            word += size
        off += size
    if len(rows) > MAX_SEGMENTS:
        raise ValueError(f"draws: {len(rows)} segments, the kernel takes at most {MAX_SEGMENTS}")
    return WordLayout(tuple(shapes.items()), tuple(rows), word, off)


def host_draws(seed: int, fids: Sequence[int], groups: Sequence[int], cadence: int,
               scene_cfg: SceneConfig, cfg: RandomizationConfig,
               coins: bool) -> Dict[str, Tensor]:
    """The plain version, on the host: the scene draws of each group in
    ``groups`` stacked (``placement.stack_draws``), ``frame`` (B,
    FRAME_WORDS) and, with ``coins``, ``coin`` (B,), from the CPU
    generators."""
    out = placement.stack_draws([
        placement.scene_draws(prng.scene_generator(seed, g * cadence, cadence), scene_cfg, cfg)
        for g in groups])
    frame = []
    for f in fids:
        gen = prng.frame_generator(seed, f)
        frame.append(torch.cat([camera_sampler.camera_draws(gen, 1)[0],
                                lighting.lighting_draws(gen, 1)[0]]))
    out["frame"] = torch.stack(frame)
    if coins:
        out["coin"] = torch.cat([torch.rand(1, generator=prng.mix_generator(seed, f))
                                 for f in fids])
    return out


def replay_cuda(layout: WordLayout, seed: int, table: Tensor, frame_ids: Tensor,
                group_ids: Tensor, coins: bool) -> Dict[str, Tensor]:
    """Launch csrc/draws.cu: ``host_draws``' tensors, bit for bit, on the
    card. ``table`` is ``layout.table`` and ``frame_ids`` (B,) and
    ``group_ids`` (G,) the batch's frames and scene groups, all int32 on the
    card."""
    n_seg = len(layout.table)
    kernels.check_cuda("draws table", table, torch.int32, (n_seg * SEG_COLS,))
    kernels.check_cuda("draws frame ids", frame_ids, torch.int32)
    kernels.check_cuda("draws group ids", group_ids, torch.int32)
    B, G = frame_ids.shape[0], group_ids.shape[0]
    out = torch.empty(G * layout.floats + B * FRAME_WORDS + (B if coins else 0),
                      dtype=torch.float32, device=frame_ids.device)
    if B or G:
        stream_keys = [prng.mix(seed, s) for s in (prng.SCENE_STREAM, prng.FRAME_STREAM,
                                                   prng.MIX_STREAM)]
        kernels.launch("cspe_draws", frame_ids, B, group_ids, G, int(coins), *stream_keys, table,
                       n_seg, layout.words, layout.floats, out)
        replay_cuda.launches += 1
        replay_cuda.streams += G + B + (B if coins else 0)
    draws, at = {}, 0
    for k, shape in layout.keys:
        size = G * math.prod(shape)
        draws[k] = out[at:at + size].view(G, *shape)
        at += size
    draws["frame"] = out[at:at + B * FRAME_WORDS].view(B, FRAME_WORDS)
    if coins:
        draws["coin"] = out[at + B * FRAME_WORDS:]
    return draws


replay_cuda.launches = 0
replay_cuda.streams = 0
