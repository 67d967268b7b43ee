"""Vectorized F_p arithmetic in 4x32-bit limbs (device compute path).

p = 2^127 - 1.  A batch of field elements is an array of shape [..., 4] with
dtype uint32, little-endian limbs (limb k holds bits 32k..32k+31), canonical
value in [0, p).  jax.numpy runs without 64-bit integers by default, so all
arithmetic is built from 32-bit lanes; multiplication goes through 16-bit
digits so partial products and column sums fit in uint32 without carry loss.

This module is backend-agnostic: every function works identically on numpy
arrays (host) and jax.numpy arrays (device, under jit).  The semantics mirror
include/pvac/core/field.hpp:50-273 bit-exactly:

- fp_from_words / canonicalization   field.hpp:26-48
- add/sub/neg                        field.hpp:50-71
- 128x128->256 multiply + Mersenne fold fp_reduce256  field.hpp:158-213
- inversion a^(p-2) (Fermat; the reference's windowed chain
  field.hpp:229-269 computes the same value)
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32
_M16 = 0xFFFF
_M31 = 0x7FFFFFFF

# p as limbs.
P_LIMBS = (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF)


def _xp(a):
    """numpy or jax.numpy, inferred from the array type."""
    if type(a).__module__.startswith("numpy"):
        return np
    import jax.numpy as jnp

    return jnp


def _u32(xp, x):
    return x.astype(U32) if hasattr(x, "astype") else xp.asarray(x, dtype=U32)


# ---------------------------------------------------------------------------
# packing / conversion helpers (host-side)
# ---------------------------------------------------------------------------

def from_u64_pairs(lo, hi):
    """(lo, hi) uint64 arrays -> [..., 4] uint32 limbs (no reduction)."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return np.stack(
        [
            (lo & np.uint64(0xFFFFFFFF)).astype(U32),
            (lo >> np.uint64(32)).astype(U32),
            (hi & np.uint64(0xFFFFFFFF)).astype(U32),
            (hi >> np.uint64(32)).astype(U32),
        ],
        axis=-1,
    )


def to_u64_pairs(limbs):
    """[..., 4] uint32 limbs -> (lo, hi) uint64 arrays."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    l = limbs.astype(np.uint64)
    lo = l[..., 0] | (l[..., 1] << np.uint64(32))
    hi = l[..., 2] | (l[..., 3] << np.uint64(32))
    return lo, hi


def from_ints(values):
    """Iterable of Python ints (in [0, 2^128)) -> [N, 4] uint32 limbs."""
    vals = list(values)
    out = np.empty((len(vals), 4), dtype=np.uint32)
    for i, v in enumerate(vals):
        out[i, 0] = v & 0xFFFFFFFF
        out[i, 1] = (v >> 32) & 0xFFFFFFFF
        out[i, 2] = (v >> 64) & 0xFFFFFFFF
        out[i, 3] = (v >> 96) & 0xFFFFFFFF
    return out


def to_ints(limbs):
    """[..., 4] uint32 limbs -> list of Python ints (flattened batch)."""
    limbs = np.asarray(limbs, dtype=np.uint32).reshape(-1, 4)
    return [
        int(r[0]) | int(r[1]) << 32 | int(r[2]) << 64 | int(r[3]) << 96
        for r in limbs
    ]


# ---------------------------------------------------------------------------
# 128-bit primitive ops on limb vectors
# ---------------------------------------------------------------------------

def _add128(xp, a, b):
    """Full 128-bit add; returns (sum_limbs, carry_out u32 in {0,1})."""
    s0 = a[..., 0] + b[..., 0]
    c = _u32(xp, s0 < a[..., 0])
    s1 = a[..., 1] + b[..., 1]
    c1 = _u32(xp, s1 < a[..., 1])
    s1 = s1 + c
    c = c1 + _u32(xp, s1 < c)
    s2 = a[..., 2] + b[..., 2]
    c2 = _u32(xp, s2 < a[..., 2])
    s2 = s2 + c
    c = c2 + _u32(xp, s2 < c)
    s3 = a[..., 3] + b[..., 3]
    c3 = _u32(xp, s3 < a[..., 3])
    s3 = s3 + c
    c = c3 + _u32(xp, s3 < c)
    return xp.stack([s0, s1, s2, s3], axis=-1), c


def _sub128(xp, a, b):
    """Full 128-bit subtract; returns (diff_limbs, borrow_out u32 in {0,1})."""
    d0 = a[..., 0] - b[..., 0]
    br = _u32(xp, a[..., 0] < b[..., 0])
    d1 = a[..., 1] - b[..., 1]
    b1 = _u32(xp, a[..., 1] < b[..., 1])
    b1 = b1 + _u32(xp, d1 < br)
    d1 = d1 - br
    br = b1
    d2 = a[..., 2] - b[..., 2]
    b2 = _u32(xp, a[..., 2] < b[..., 2])
    b2 = b2 + _u32(xp, d2 < br)
    d2 = d2 - br
    br = b2
    d3 = a[..., 3] - b[..., 3]
    b3 = _u32(xp, a[..., 3] < b[..., 3])
    b3 = b3 + _u32(xp, d3 < br)
    d3 = d3 - br
    br = b3
    return xp.stack([d0, d1, d2, d3], axis=-1), br


def _p_like(xp, a):
    p = xp.asarray(P_LIMBS, dtype=U32)
    return xp.broadcast_to(p, a.shape)


def _cond_sub_p(xp, a):
    """a in [0, p]; return a - p if a >= p else a (canonical)."""
    p = _p_like(xp, a)
    d, br = _sub128(xp, a, p)
    keep = (br != 0)[..., None]
    return xp.where(keep, a, d)


def canon(limbs):
    """Canonicalize an arbitrary 128-bit limb vector into [0, p).

    Semantics of fp_from_words (field.hpp:26-48): fold bit 127, then one
    conditional subtract.
    """
    xp = _xp(limbs)
    a = limbs
    extra = a[..., 3] >> U32(31)  # bit 127
    a = xp.stack([a[..., 0], a[..., 1], a[..., 2], a[..., 3] & U32(_M31)], axis=-1)
    z = xp.zeros_like(a)
    e = xp.stack([extra, z[..., 0], z[..., 0], z[..., 0]], axis=-1)
    s, _ = _add128(xp, a, e)
    # After the fold s <= p + 1 < 2^127, so one conditional subtract suffices.
    return _cond_sub_p(xp, s)


def add(a, b):
    """fp_add (field.hpp:50-56)."""
    xp = _xp(a)
    s, carry = _add128(xp, a, b)
    # a, b < p  =>  s < 2^128 - 2, carry_out always 0; bit 127 may be set.
    del carry
    return canon(s)


def neg(a):
    """fp_neg (field.hpp:58-67): p - a, canonicalized (p -> 0)."""
    xp = _xp(a)
    p = _p_like(xp, a)
    d, _ = _sub128(xp, p, a)
    return _cond_sub_p(xp, d)


def sub(a, b):
    """fp_sub = a + (p - b) (field.hpp:69-71)."""
    return add(a, neg(b))


def _digits16(xp, a):
    """[..., 4] u32 -> list of 8 u32 arrays holding 16-bit digits."""
    out = []
    for k in range(4):
        limb = a[..., k]
        out.append(limb & U32(_M16))
        out.append(limb >> U32(16))
    return out


def mul(a, b):
    """fp_mul: 128x128->256 product + Mersenne fold (field.hpp:158-213).

    Schoolbook over 16-bit digits: 64 partial products, each < 2^32; column
    accumulators stay < 2^21 so uint32 lanes never lose carries.
    """
    xp = _xp(a)
    ad = _digits16(xp, a)
    bd = _digits16(xp, b)

    # acc[k] accumulates 16-bit quantities contributing to digit k.
    acc = [None] * 17
    for i in range(8):
        for j in range(8):
            p = ad[i] * bd[j]
            lo = p & U32(_M16)
            hi = p >> U32(16)
            k = i + j
            acc[k] = lo if acc[k] is None else acc[k] + lo
            acc[k + 1] = hi if acc[k + 1] is None else acc[k + 1] + hi

    # Carry-propagate into 16 clean 16-bit digits.
    digs = []
    c = xp.zeros_like(ad[0])
    for k in range(16):
        t = (acc[k] if acc[k] is not None else xp.zeros_like(ad[0])) + c
        digs.append(t & U32(_M16))
        c = t >> U32(16)
    # product < 2^254 -> no carry past digit 15.

    # Reassemble into 8 u32 limbs z[0..7].
    z = [digs[2 * k] | (digs[2 * k + 1] << U32(16)) for k in range(8)]

    # L = z mod 2^127 ; H = z >> 127 (z < 2^254 => H < 2^127).
    L = xp.stack([z[0], z[1], z[2], z[3] & U32(_M31)], axis=-1)
    z.append(xp.zeros_like(z[0]))  # z[8] = 0
    H = xp.stack(
        [(z[3 + k] >> U32(31)) | (z[4 + k] << U32(1)) for k in range(4)],
        axis=-1,
    )
    x, _ = _add128(xp, L, H)  # x < 2^128 - 2
    return canon(x)


def sqr(a):
    return mul(a, a)


def _sqr_n(x, n: int):
    """x^(2^n).  Uses lax.fori_loop on the JAX path so the repeated-squaring
    chain compiles as one loop instead of n inlined multiplier graphs."""
    if n == 0:
        return x
    if _xp(x) is np:
        for _ in range(n):
            x = sqr(x)
        return x
    import jax.lax as lax

    return lax.fori_loop(0, n, lambda _, v: sqr(v), x)


def _pow_2k_mul(x, k, y):
    """x^(2^k) * y."""
    return mul(_sqr_n(x, k), y)


def inv(a):
    """a^(p-2), p-2 = 2^127 - 3 = (2^125 - 1)*4 + 1.

    Addition chain: build a^(2^125-1) by doubling the all-ones exponent
    (1,2,4,8,16,32,64 -> 96 -> 112 -> 120 -> 124 -> 125), then square twice
    and multiply by a.  125 squarings + 11 multiplies + 2 squarings + 1 mul.
    inv(0) = 0 (the reference never inverts zero).
    """
    x1 = a
    x2 = _pow_2k_mul(x1, 1, x1)      # 2^2-1
    x4 = _pow_2k_mul(x2, 2, x2)      # 2^4-1
    x8 = _pow_2k_mul(x4, 4, x4)
    x16 = _pow_2k_mul(x8, 8, x8)
    x32 = _pow_2k_mul(x16, 16, x16)
    x64 = _pow_2k_mul(x32, 32, x32)
    x96 = _pow_2k_mul(x64, 32, x32)
    x112 = _pow_2k_mul(x96, 16, x16)
    x120 = _pow_2k_mul(x112, 8, x8)
    x124 = _pow_2k_mul(x120, 4, x4)
    x125 = _pow_2k_mul(x124, 1, x1)  # a^(2^125-1)
    return _pow_2k_mul(x125, 2, x1)  # (a^(2^125-1))^4 * a = a^(2^127-3)


def pow_u64(a, e: int):
    """a^e for a *static* Python-int exponent (square-and-multiply)."""
    xp = _xp(a)
    one = xp.broadcast_to(xp.asarray([1, 0, 0, 0], dtype=U32), a.shape)
    r = one
    base = a
    while e:
        if e & 1:
            r = mul(r, base)
        e >>= 1
        if e:
            base = sqr(base)
    return r


def canon_u64_limbs(acc):
    """[..., 4] uint64 limb accumulators (limb k has weight 2^32k, each limb
    an unreduced sum < 2^63) -> [..., 4] uint32 canonical field elements.

    Used to reduce segment-summed edge weights (compact_edges / ct_mul bucket
    aggregation) without Python-int math: carry-propagate the u64 limbs into
    a 128-bit value plus an overflow o < 2^34, then fold with 2^128 = 2
    (mod p, since 2^127 = 1).
    """
    acc = np.asarray(acc, dtype=np.uint64)
    limbs = []
    c = np.zeros(acc.shape[:-1], dtype=np.uint64)
    for k in range(4):
        t = acc[..., k] + c  # acc limbs < 2^63, c <= 2^32 -> no u64 overflow
        limbs.append((t & np.uint64(0xFFFFFFFF)).astype(U32))
        c = t >> np.uint64(32)
    x = canon(np.stack(limbs, axis=-1))
    # overflow contributes c * 2^128 = 2c (mod p); 2c < 2^34 fits two limbs
    o = c << np.uint64(1)
    o_limbs = np.stack(
        [
            (o & np.uint64(0xFFFFFFFF)).astype(U32),
            (o >> np.uint64(32)).astype(U32),
            np.zeros_like(c, dtype=U32),
            np.zeros_like(c, dtype=U32),
        ],
        axis=-1,
    )
    return add(x, canon(o_limbs))


def is_zero(a):
    """Boolean mask [...,] of which elements are zero."""
    xp = _xp(a)
    return (a[..., 0] | a[..., 1] | a[..., 2] | a[..., 3]) == 0


def select(mask, a, b):
    """Elementwise select: mask broadcast over the limb axis."""
    xp = _xp(a)
    return xp.where(mask[..., None], a, b)
