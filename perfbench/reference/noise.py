"""The ends of the RGB's hash noise, for the check of a generate cell.

The shading multiplies each hit pixel's colour by 1 + 0.15 s (2 n - 1), with
n the hash noise in [0, 1) and s the frame's texture strength: one factor for
the three channels, and the colour rises with it through the clamp, the
gamma and the rounding to u8. So whatever the noise reads, a pixel lies
between the images made with n held at 0 and at 1. The noise itself cannot
be compared pixel by pixel (``harness/compare.rgb_gaps``); a pixel outside
those two images is off by more than any noise can explain.

Inside ``noise_ends(held)`` each call of the reference's RGB pass
(``rgb_kernel.plain_rgb``) is made as it is and twice more, with n at 0 and
at 1; ``held["lo"]`` and ``held["hi"]`` collect those images in call order.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def noise_ends(held: dict):
    from reference.plain.render import rgb_kernel, shading

    plain, noise = rgb_kernel.plain_rgb, shading._hash_noise
    held.setdefault("lo", [])
    held.setdefault("hi", [])

    def at(n):
        return lambda x, y, z, scale=7.0: torch.full_like(x, n)

    def rgb(*args, **kw):
        try:
            for key, n in (("lo", 0.0), ("hi", 1.0)):
                shading._hash_noise = at(n)
                held[key].append(plain(*args, **kw))
        finally:
            shading._hash_noise = noise
        return plain(*args, **kw)

    rgb_kernel.plain_rgb = rgb
    try:
        yield held
    finally:
        rgb_kernel.plain_rgb = plain
