"""Error-free transforms of float32 tensors (IEEE add/sub/mul only).

Ported from ``proteus_tpu/core/f32exact.py:96-116`` (``_two_sum``,
``_split``, ``_two_prod``). Eager PyTorch runs every operation as its own
kernel and never reassociates, so the reference's ``_opaque`` barrier has
no counterpart here. Never write ``addcmul``, ``lerp`` or ``torch.compile``
into this code: each can contract ``a*b+c`` into one fused multiply-add,
which breaks the Veltkamp split and the TwoProduct error term.

All operands are float32 tensors on one device (constants as 0-dim
tensors), so no Python float ever takes part in the arithmetic.
"""

import torch


def f32(value, like):
    """A 0-dim float32 tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def split(a):
    """Veltkamp split of a float32 into two 12-bit halves."""
    c = a * f32(4097.0, a)  # 2**12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProduct: p + e == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e
