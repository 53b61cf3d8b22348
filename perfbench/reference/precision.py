"""The reference's matrix products in TF32, for the control of a generate
cell, whose configuration states float32 with TF32 off.

``allow_tf32`` changes only the products that cuBLAS runs on tensor cores,
and the proxy path's 3 x 3 rotations run on none, so the flag alone leaves
every bit of them as it was. Inside ``tf32_products()`` each float32 input
of ``torch.einsum``, ``torch.matmul``, ``torch.bmm`` and ``@`` is rounded to
TF32's 10 mantissa bits first (to nearest, ties away from zero), as a
tensor core reads it; the sums stay float32.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x):
    """``x`` with each float32 value rounded to 10 mantissa bits; anything
    else as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    r = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def round_bf16(x):
    """``x`` with each float32 value rounded to bfloat16 and back."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def bf16_rgb():
    """The reference's RGB pass (``rgb_kernel.plain_rgb``) reading its float
    inputs (hit distances, instance table, AO table, per-frame parameters)
    in bfloat16: no matrix product there for TF32 to round, so the next
    precision below float32, as a pass that halves its bytes would."""
    from reference.plain.render import rgb_kernel

    plain = rgb_kernel.plain_rgb
    rgb_kernel.plain_rgb = lambda *args, **kw: plain(*(round_bf16(a) for a in args), **kw)
    try:
        yield
    finally:
        rgb_kernel.plain_rgb = plain


@contextlib.contextmanager
def control():
    """The generate cells' control: TF32 products and a bfloat16 RGB pass."""
    with tf32_products(), bf16_rgb():
        yield


@contextlib.contextmanager
def tf32_products():
    T = torch.Tensor
    saved = (torch.einsum, torch.matmul, torch.bmm, T.__matmul__, T.matmul, T.bmm,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    einsum, matmul, bmm, t_matmul, t_matmul2, t_bmm = saved[:6]

    def _einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        return einsum(eq, *(round_tf32(o) for o in ops))

    torch.einsum = _einsum
    torch.matmul = lambda a, b, **kw: matmul(round_tf32(a), round_tf32(b), **kw)
    torch.bmm = lambda a, b, **kw: bmm(round_tf32(a), round_tf32(b), **kw)
    T.__matmul__ = lambda a, b: t_matmul(round_tf32(a), round_tf32(b))
    T.matmul = lambda a, b: t_matmul2(round_tf32(a), round_tf32(b))
    T.bmm = lambda a, b: t_bmm(round_tf32(a), round_tf32(b))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.einsum, torch.matmul, torch.bmm, T.__matmul__, T.matmul, T.bmm,
         torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved
