"""GF(2) Toeplitz extractor (reference: include/pvac/crypto/toeplitz.hpp).

The reference computes a full carry-less convolution of the t-bit LPN output
with a (t+127)-bit pseudorandom top row, then keeps bits 0..126
(toeplitz.hpp:121-190).  Bit k of a GF(2) convolution depends only on
operand bits 0..k, so the 127 output bits depend only on the first 127 bits
of each operand — verified bit-exactly against the reference
(tools/refharness/check_toep.cpp).  The vectorized path therefore convolves two
127-bit operands; the scalar path keeps the reference's full-width shape for
API parity and cross-checks.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32


def _xp(a):
    if type(a).__module__.startswith("numpy"):
        return np
    import jax.numpy as jnp

    return jnp


# ---------------------------------------------------------------------------
# scalar path (python ints; mirrors gf2_conv_scalar / toep_127_scalar)
# ---------------------------------------------------------------------------

def gf2_conv_scalar(a_words: list[int], b_words: list[int]) -> list[int]:
    """Carry-less product of two bit strings given as u64 word lists
    (toeplitz.hpp:22-48).  Returns len(a)+len(b) u64 words."""
    A = 0
    for i, w in enumerate(a_words):
        A |= (w & 0xFFFFFFFFFFFFFFFF) << (64 * i)
    B = 0
    for i, w in enumerate(b_words):
        B |= (w & 0xFFFFFFFFFFFFFFFF) << (64 * i)
    R = 0
    while A:
        low = A & -A
        R ^= B << (low.bit_length() - 1)
        A ^= low
    n = len(a_words) + len(b_words)
    return [(R >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def toep_127_scalar(top_words: list[int], y_words: list[int]) -> tuple[int, int]:
    """toep_127 (toeplitz.hpp:121-140): conv(y, top), keep bits 0..126 as
    (lo, hi) u64 pair."""
    r = gf2_conv_scalar(y_words, top_words)
    val = (r[0] | (r[1] << 64)) & ((1 << 127) - 1)
    return val & 0xFFFFFFFFFFFFFFFF, val >> 64


def toep_127(top_words: list[int], y_words: list[int]) -> tuple[int, int]:
    """Reference-named entry point (toeplitz.hpp:259-267).  The runtime
    backend dispatch (scalar here, conv127 on device) replaces the
    reference's micro-benchmark autotuner."""
    return toep_127_scalar(top_words, y_words)


# ---------------------------------------------------------------------------
# vectorized 127-bit convolution (numpy / jnp)
# ---------------------------------------------------------------------------

def conv127(y4, top4):
    """Batched 127-bit GF(2) convolution, truncated to 127 output bits.

    y4, top4: [..., 4] uint32 (bits 0..126 significant).  Returns [..., 4]
    uint32 with bits 0..126 of conv(y, top).

    127 static shift-XOR steps; each step shifts the 128-bit top operand
    left by one and conditionally XORs it under the corresponding y-bit
    mask.  Overflow past bit 127 is discarded (never read).
    """
    xp = _xp(y4)
    acc = [xp.zeros_like(y4[..., 0]) for _ in range(4)]
    t = [top4[..., k] for k in range(4)]
    for a in range(127):
        w, s = divmod(a, 32)
        # shifted[k] = limb k of (top << a)
        ybit = (y4[..., a // 32] >> U32(a % 32)) & U32(1)
        mask = U32(0) - ybit
        for k in range(w, 4):
            if s == 0:
                sh = t[k - w]
            else:
                lo = t[k - w] << U32(s)
                hi = t[k - w - 1] >> U32(32 - s) if k - w - 1 >= 0 else None
                sh = lo if hi is None else lo | hi
            acc[k] = acc[k] ^ (sh & mask)
    out = xp.stack(acc, axis=-1)
    # clear bit 127
    top_mask = xp.asarray([0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF], dtype=U32)
    return out & top_mask
