"""Bitsliced vectorized AES-256-CTR (the device keystream engine).

XLA has no AES instructions, so AES runs as a boolean circuit over uint32
lanes: bit b of byte position p of 32 consecutive counter blocks lives in one
uint32 (block index within the group = bit position in the lane word).  The
S-box is computed arithmetically — GF(2^8) inversion by Fermat (x^254) with
all linear maps (squaring, xtime, the affine transform) derived
programmatically from the field definition — so the circuit is correct by
construction and verified exhaustively against the table oracle in
:mod:`.aes`.

Semantics match the reference AES-NI engine (include/pvac/crypto/lpn.hpp:
41-149): counter block k = le64(nonce+k) || 0^8, keystream read as
little-endian u64s.

Backend-agnostic (numpy / jax.numpy); shapes are static so everything jits.

Data layout:
- cipher state: list of 8 bit-planes, each [16, N, G] uint32
  (byte position 0..15, lane n, block group g; 32 blocks per u32)
- round keys: [15, 16, 8, N] uint32 masks (0 or 0xffffffff), broadcast over G
"""
from __future__ import annotations

import numpy as np

from .aes import SBOX  # table oracle, used only in tests

U32 = np.uint32


def _xp(a):
    if type(a).__module__.startswith("numpy"):
        return np
    import jax.numpy as jnp

    return jnp


# ---------------------------------------------------------------------------
# GF(2^8) linear maps, derived from the field definition at import time
# ---------------------------------------------------------------------------

def _gf_mul_int(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _linear_map_masks(f) -> list[int]:
    """For a GF(2)-linear byte map f, masks[j] = set of input bits XORed into
    output bit j."""
    masks = [0] * 8
    for i in range(8):
        y = f(1 << i)
        for j in range(8):
            if (y >> j) & 1:
                masks[j] |= 1 << i
    return masks


_SQ_MASKS = _linear_map_masks(lambda x: _gf_mul_int(x, x))
_XT_MASKS = _linear_map_masks(lambda x: _gf_mul_int(x, 2))


def _affine_fwd(x: int) -> int:
    out = 0
    for i in range(8):
        bit = (
            (x >> i) ^ (x >> ((i + 4) % 8)) ^ (x >> ((i + 5) % 8))
            ^ (x >> ((i + 6) % 8)) ^ (x >> ((i + 7) % 8))
        ) & 1
        out |= bit << i
    return out


_AFF_MASKS = _linear_map_masks(_affine_fwd)
_AFF_CONST = 0x63


def _apply_linear(planes, masks):
    """planes: list of 8 arrays (bit i).  out bit j = XOR of planes[i] for
    i in masks[j]."""
    out = []
    for j in range(8):
        acc = None
        m = masks[j]
        for i in range(8):
            if (m >> i) & 1:
                acc = planes[i] if acc is None else acc ^ planes[i]
        out.append(acc)
    return out


def _sq(planes):
    return _apply_linear(planes, _SQ_MASKS)


def _xt(planes):
    return _apply_linear(planes, _XT_MASKS)


def _gf_mul_planes(a, b):
    """Bitsliced GF(2^8) multiply: 8 shift-and-add steps."""
    acc = [None] * 8
    t = a
    for i in range(8):
        bi = b[i]
        for j in range(8):
            v = t[j] & bi
            acc[j] = v if acc[j] is None else acc[j] ^ v
        if i < 7:
            t = _xt(t)
    return acc


def sbox_planes_fermat(x):
    """Bitsliced AES S-box by Fermat inversion: affine(x^254).  ~710 ops;
    kept as the independent cross-check for the tower-field circuit."""
    x2 = _sq(x)
    x3 = _gf_mul_planes(x2, x)
    x6 = _sq(x3)
    x7 = _gf_mul_planes(x6, x)
    x12 = _sq(x6)
    x15 = _gf_mul_planes(x12, x3)
    x120 = _sq(_sq(_sq(x15)))
    x127 = _gf_mul_planes(x120, x7)
    x254 = _sq(x127)
    out = _apply_linear(x254, _AFF_MASKS)
    for j in range(8):
        if (_AFF_CONST >> j) & 1:
            out[j] = ~out[j]
    return out


# ---------------------------------------------------------------------------
# Tower-field S-box: GF(2^8) ~ GF(((2^2)^2)^2), inversion via the composite
# structure (~200 ops, ~3.5x fewer than Fermat).  The isomorphism and all
# constants are DERIVED at import from the field definitions and verified
# exhaustively below (and again in tests) — nothing is hand-copied.
#
# Packing: tower element = a*16 + b  (x = a*y + b, a,b in GF16)
#          GF16 element  = c*4 + d   (x = c*z + d, c,d in GF4)
#          GF4  element  = e*2 + f   (x = e*w + f), w^2 = w + 1
# Moduli:  z^2 = z + N with N = w (packed 2), y^2 = y + nu (searched).
# ---------------------------------------------------------------------------

def _gf4_mul_int(x, y):
    x0, x1 = x & 1, x >> 1
    y0, y1 = y & 1, y >> 1
    t = (x0 ^ x1) & (y0 ^ y1)
    hi = t ^ x0 & y0
    lo = (x0 & y0) ^ (x1 & y1)
    return (hi << 1) | lo


def _gf4_scale_N_int(x):  # * w
    x0, x1 = x & 1, x >> 1
    return ((x0 ^ x1) << 1) | x1


def _gf16_mul_int(x, y):
    d1, c1 = x & 3, x >> 2
    d2, c2 = y & 3, y >> 2
    m1 = _gf4_mul_int(c1, c2)
    m2 = _gf4_mul_int(d1, d2)
    m3 = _gf4_mul_int(c1 ^ d1, c2 ^ d2)
    c = m3 ^ m2
    d = m2 ^ _gf4_scale_N_int(m1)
    return (c << 2) | d


def _find_nu():
    # nu in GF16 with y^2 + y + nu irreducible (no root in GF16)
    for nu in range(1, 16):
        if all(_gf16_mul_int(t, t) ^ t != nu for t in range(16)):
            return nu
    raise AssertionError("no irreducible nu")


_NU = _find_nu()


def _tower_mul_int(x, y):
    b1, a1 = x & 15, x >> 4
    b2, a2 = y & 15, y >> 4
    m1 = _gf16_mul_int(a1, a2)
    m2 = _gf16_mul_int(b1, b2)
    m3 = _gf16_mul_int(a1 ^ b1, a2 ^ b2)
    a = m3 ^ m2
    b = m2 ^ _gf16_mul_int(_NU, m1)
    return (a << 4) | b


def _build_tower_iso():
    # roots of the AES modulus x^8+x^4+x^3+x+1 in the tower field give ring
    # isomorphisms; T maps AES basis x^i -> r^i.
    def aes_poly_at(r):
        def powi(v, k):
            out = 1
            for _ in range(k):
                out = _tower_mul_int(out, v)
            return out
        return powi(r, 8) ^ powi(r, 4) ^ powi(r, 3) ^ r ^ 1

    root = next(r for r in range(2, 256) if aes_poly_at(r) == 0)
    cols = []
    v = 1
    for _ in range(8):
        cols.append(v)
        v = _tower_mul_int(v, root)
    # T (AES->tower): bit j of T(x) = parity over i of (x bit i) * (cols[i] bit j)
    T = [0] * 8  # T[j] = mask of input bits feeding output bit j
    for i in range(8):
        for j in range(8):
            if (cols[i] >> j) & 1:
                T[j] |= 1 << i

    def apply_rows(rows, x):
        out = 0
        for j in range(8):
            if bin(x & rows[j]).count("1") & 1:
                out |= 1 << j
        return out

    # invert T over GF(2)
    mat = [[(T[j] >> i) & 1 for i in range(8)] for j in range(8)]
    inv = [[1 if i == j else 0 for i in range(8)] for j in range(8)]
    for col in range(8):
        piv = next(r for r in range(col, 8) if mat[r][col])
        mat[col], mat[piv] = mat[piv], mat[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(8):
            if r != col and mat[r][col]:
                mat[r] = [a ^ b for a, b in zip(mat[r], mat[col])]
                inv[r] = [a ^ b for a, b in zip(inv[r], inv[col])]
    Tinv = [sum(inv[j][i] << i for i in range(8)) for j in range(8)]
    # M_out = Affine o Tinv (row masks), output constant 0x63
    Mout = [0] * 8
    for j in range(8):
        # affine output bit j = parity(AFF_MASKS[j] & y) with y = Tinv(x)
        m = 0
        for k in range(8):
            if (_AFF_MASKS[j] >> k) & 1:
                m ^= Tinv[k]
        Mout[j] = m
    return T, Mout


_T_IN, _M_OUT = _build_tower_iso()


def _verify_tower():
    from .aes import SBOX

    def apply_rows(rows, x):
        out = 0
        for j in range(8):
            if bin(x & rows[j]).count("1") & 1:
                out |= 1 << j
        return out

    def tower_inv(t):
        if t == 0:
            return 0
        acc, base, e = 1, t, 254
        while e:
            if e & 1:
                acc = _tower_mul_int(acc, base)
            base = _tower_mul_int(base, base)
            e >>= 1
        return acc

    for x in range(256):
        s = apply_rows(_M_OUT, tower_inv(apply_rows(_T_IN, x))) ^ _AFF_CONST
        assert s == SBOX[x], f"tower iso broken at {x}"


_verify_tower()


def _gf4_mul_p(x, y):
    # x, y: (f, e) plane pairs
    t = (x[0] ^ x[1]) & (y[0] ^ y[1])
    m00 = x[0] & y[0]
    return (m00 ^ (x[1] & y[1]), t ^ m00)


def _gf4_sq_p(x):
    return (x[0] ^ x[1], x[1])


def _gf4_scale_N_p(x):
    return (x[1], x[0] ^ x[1])


def _gf16_mul_p(x, y):
    # x = (d0, d1, c0, c1)
    d1, c1 = x[:2], x[2:]
    d2, c2 = y[:2], y[2:]
    m1 = _gf4_mul_p(c1, c2)
    m2 = _gf4_mul_p(d1, d2)
    m3 = _gf4_mul_p((c1[0] ^ d1[0], c1[1] ^ d1[1]),
                    (c2[0] ^ d2[0], c2[1] ^ d2[1]))
    c = (m3[0] ^ m2[0], m3[1] ^ m2[1])
    nm1 = _gf4_scale_N_p(m1)
    d = (m2[0] ^ nm1[0], m2[1] ^ nm1[1])
    return (*d, *c)


def _gf16_sq_p(x):
    d, c = x[:2], x[2:]
    c2 = _gf4_sq_p(c)
    d2 = _gf4_sq_p(d)
    nc2 = _gf4_scale_N_p(c2)
    return (d2[0] ^ nc2[0], d2[1] ^ nc2[1], c2[0], c2[1])


def _gf16_scale_nu_p(x):
    # multiply by the constant _NU: linear map derived from the int model
    out = [None] * 4
    for j in range(4):
        acc = None
        for i in range(4):
            if (_gf16_mul_int(_NU, 1 << i) >> j) & 1:
                acc = x[i] if acc is None else acc ^ x[i]
        out[j] = acc if acc is not None else x[0] ^ x[0]
    return tuple(out)


def _gf16_inv_p(x):
    # (cz + d)^-1 = (cz + c + d) * Delta^-1, Delta = c^2 N + cd + d^2
    d, c = x[:2], x[2:]
    c2 = _gf4_sq_p(c)
    d2 = _gf4_sq_p(d)
    cd = _gf4_mul_p(c, d)
    nc2 = _gf4_scale_N_p(c2)
    delta = (nc2[0] ^ cd[0] ^ d2[0], nc2[1] ^ cd[1] ^ d2[1])
    dinv = _gf4_sq_p(delta)  # GF4 inverse == square
    c_out = _gf4_mul_p(c, dinv)
    d_out = _gf4_mul_p((c[0] ^ d[0], c[1] ^ d[1]), dinv)
    return (*d_out, *c_out)


def sbox_planes(x):
    """Bitsliced AES S-box via the tower-field inversion (~200 ops)."""
    # input linear layer: tower bit j = parity(_T_IN[j] & x)
    t = []
    for j in range(8):
        acc = None
        m = _T_IN[j]
        for i in range(8):
            if (m >> i) & 1:
                acc = x[i] if acc is None else acc ^ x[i]
        t.append(acc if acc is not None else x[0] & ~x[0])

    b, a = tuple(t[:4]), tuple(t[4:])
    # Delta = a^2 nu + ab + b^2 ; inv = Delta^-1 ; a' = a*inv, b' = (a+b)*inv
    a2nu = _gf16_scale_nu_p(_gf16_sq_p(a))
    ab = _gf16_mul_p(a, b)
    b2 = _gf16_sq_p(b)
    delta = tuple(a2nu[k] ^ ab[k] ^ b2[k] for k in range(4))
    dinv = _gf16_inv_p(delta)
    a_out = _gf16_mul_p(a, dinv)
    apb = tuple(a[k] ^ b[k] for k in range(4))
    b_out = _gf16_mul_p(apb, dinv)
    inv = (*b_out, *a_out)

    # output linear layer + affine constant
    out = []
    for j in range(8):
        acc = None
        m = _M_OUT[j]
        for i in range(8):
            if (m >> i) & 1:
                acc = inv[i] if acc is None else acc ^ inv[i]
        if acc is None:
            acc = inv[0] & ~inv[0]
        if (_AFF_CONST >> j) & 1:
            acc = ~acc
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# 32x32 bit-matrix transpose (functional butterfly)
# ---------------------------------------------------------------------------

def bit_transpose_32(rows):
    """rows: list of 32 uint32 arrays.  Returns cols with
    bit i of cols[j] == bit j of rows[i]."""
    x = list(rows)
    j = 16
    m = U32(0x0000FFFF)
    while j:
        for k in range(32):
            if k & j == 0:
                t = (x[k] >> U32(j)) ^ x[k + j]
                t = t & m
                x[k + j] = x[k + j] ^ t
                x[k] = x[k] ^ (t << U32(j))
        j >>= 1
        if j:
            m = U32(int(m) ^ (int(m) << j) & 0xFFFFFFFF)
    return x


# ---------------------------------------------------------------------------
# key expansion (bitsliced over N lanes packed 32-per-u32)
# ---------------------------------------------------------------------------

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40]


def _pack_lanes(bits):
    """bits: numpy uint32 [..., N] in {0,1} -> packed [..., ceil(N/32)]
    (host-side packing; used to prepare key planes)."""
    n = bits.shape[-1]
    nw = (n + 31) // 32
    pad = nw * 32 - n
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], pad), dtype=U32)], axis=-1
        )
    bits = bits.reshape(*bits.shape[:-1], nw, 32)
    sh = np.arange(32, dtype=U32)
    return (bits << sh).sum(axis=-1, dtype=np.uint64).astype(U32)


def expand_keys_bitsliced(keys_bytes: np.ndarray):
    """keys_bytes: [N, 32] uint8 (numpy, host side).

    Returns round-key masks [15, 16, 8, N] uint32 (0 / 0xffffffff): round r,
    byte position p (state indexing), bit b, lane n.
    """
    return rk_masks_from_packed(_expand_schedule(keys_bytes), keys_bytes.shape[0])


def _stack_rk_planes(wb) -> np.ndarray:
    planes_flat = []
    for r in range(15):
        for p in range(16):
            c, k = p // 4, p % 4
            for b in range(8):
                planes_flat.append(wb[4 * r + c][k][b])
    return np.stack(planes_flat)  # [15*16*8, nw]


def expand_keys_packed(keys_bytes: np.ndarray) -> np.ndarray:
    """Like expand_keys_bitsliced but returns the lane-packed planes
    [15*16*8, ceil(N/32)] uint32 — ~32x smaller than the mask form, for
    cheap host->device transfer; unpack on device with
    rk_masks_from_packed.  Uses the native C++ schedule when available."""
    from .. import native

    out = native.expand_keys_packed(keys_bytes)
    if out is not None:
        return out
    return _expand_schedule(keys_bytes)


def _expand_schedule(keys_bytes: np.ndarray) -> np.ndarray:
    N = keys_bytes.shape[0]
    kb = keys_bytes.astype(U32)
    wb = []
    for i in range(8):
        word = []
        for k in range(4):
            byte = kb[:, 4 * i + k]
            word.append([_pack_lanes((byte >> U32(b)) & U32(1)) for b in range(8)])
        wb.append(word)

    def subword(word):
        planes = [np.stack([word[k][b] for k in range(4)]) for b in range(8)]
        planes = sbox_planes(planes)
        return [[planes[b][k] for b in range(8)] for k in range(4)]

    def rotword(word):
        return [word[1], word[2], word[3], word[0]]

    for i in range(8, 60):
        t = wb[i - 1]
        if i % 8 == 0:
            t = subword(rotword(t))
            rcon = _RCON[i // 8 - 1]
            t = [list(tb) for tb in t]
            for b in range(8):
                if (rcon >> b) & 1:
                    t[0][b] = ~t[0][b]
        elif i % 8 == 4:
            t = subword(t)
        wb.append(
            [[wb[i - 8][k][b] ^ t[k][b] for b in range(8)] for k in range(4)]
        )
    return _stack_rk_planes(wb)


def rk_masks_from_packed(packed, N: int):
    """[1920, nw] packed planes -> [15, 16, 8, N] uint32 masks
    (0 / 0xffffffff).  Works on numpy and jnp (device-side unpack)."""
    xp = _xp(packed)
    lane = xp.arange(N)
    bit = (packed[:, lane // 32] >> (lane % 32).astype(U32)) & U32(1)
    masks = (xp.zeros_like(bit) - bit).astype(U32)
    return masks.reshape(15, 16, 8, N)


# ---------------------------------------------------------------------------
# CTR block cipher
# ---------------------------------------------------------------------------

_SHIFTROWS_PERM = [(p % 4) + 4 * ((p // 4 + p % 4) % 4) for p in range(16)]
# new[p = r + 4c] = old[r + 4*((c + r) % 4)]
_MIX_P1 = [((p % 4 + 1) % 4) + 4 * (p // 4) for p in range(16)]
_MIX_P2 = [((p % 4 + 2) % 4) + 4 * (p // 4) for p in range(16)]
_MIX_P3 = [((p % 4 + 3) % 4) + 4 * (p // 4) for p in range(16)]


def _gather_pos(xp, planes, perm):
    idx = xp.asarray(perm)
    return [pl[idx] for pl in planes]


def counters_to_planes(nonce_lo, nonce_hi, n_blocks: int):
    """nonce (lo32, hi32) uint32 [N] -> state planes (list of 8 arrays
    [16, N, G]) for counter blocks 0..n_blocks-1, zero-padded to G groups."""
    xp = _xp(nonce_lo)
    N = nonce_lo.shape[0]
    G = (n_blocks + 31) // 32
    c = xp.arange(G * 32, dtype=U32)  # [B']
    lo = nonce_lo[:, None] + c[None, :]  # [N, B'] wrapping
    carry = (lo < nonce_lo[:, None]).astype(U32)
    hi = nonce_hi[:, None] + carry
    lo = lo.reshape(N, G, 32)
    hi = hi.reshape(N, G, 32)
    sh = xp.arange(32, dtype=U32)

    planes = []
    for b in range(8):
        pos = []
        for p in range(16):
            if p < 4:
                bits = (lo >> U32(8 * p + b)) & U32(1)
            elif p < 8:
                bits = (hi >> U32(8 * (p - 4) + b)) & U32(1)
            else:
                bits = None
            if bits is None:
                pos.append(xp.zeros((N, G), dtype=U32))
            else:
                pos.append((bits << sh).sum(axis=-1).astype(U32))
        planes.append(xp.stack(pos))  # [16, N, G]
    return planes


def counters_to_planes_gn(nonce_lo, nonce_hi, n_blocks: int):
    """counters_to_planes in G-major layout: planes are [16, G, N].

    The minor axis is then N (a power of two by the engine's lane
    padding) instead of G = ceil(n_blocks/32), which is 129 at the PRF
    shape.  Built transposed from the start (no per-plane transposes)."""
    xp = _xp(nonce_lo)
    N = nonce_lo.shape[0]
    G = (n_blocks + 31) // 32
    c = xp.arange(G * 32, dtype=U32)
    lo = nonce_lo[None, :] + c[:, None]          # [B', N] wrapping
    carry = (lo < nonce_lo[None, :]).astype(U32)
    hi = nonce_hi[None, :] + carry
    lo = lo.reshape(G, 32, N)
    hi = hi.reshape(G, 32, N)
    sh = xp.arange(32, dtype=U32)[None, :, None]

    planes = []
    for b in range(8):
        pos = []
        for p in range(16):
            if p < 4:
                bits = (lo >> U32(8 * p + b)) & U32(1)
            elif p < 8:
                bits = (hi >> U32(8 * (p - 4) + b)) & U32(1)
            else:
                bits = None
            if bits is None:
                pos.append(xp.zeros((G, N), dtype=U32))
            else:
                pos.append((bits << sh).sum(axis=1).astype(U32))
        planes.append(xp.stack(pos))  # [16, G, N]
    return planes


def encrypt_planes_gn(rk_masks, planes, unroll: bool = False):
    """encrypt_planes for the G-major layout ([16, G, N] planes); only the
    round-key broadcast axis differs."""
    return _encrypt_planes_core(rk_masks, planes, gn=True, unroll=unroll)


def planes_to_words_gn(planes, n_blocks: int):
    """G-major output planes -> keystream words [N, n_blocks, 4] uint32."""
    xp = _xp(planes[0])
    N = planes[0].shape[2]
    out_words = []
    for w in range(4):
        rows = []
        for i in range(32):
            p, b = 4 * w + i // 8, i % 8
            rows.append(planes[b][p])  # [G, N]
        cols = bit_transpose_32(rows)
        stacked = xp.stack(cols, axis=-1)            # [G, N, 32]
        blocks_major = xp.swapaxes(stacked, 0, 1)    # [N, G, 32]
        out_words.append(blocks_major.reshape(N, -1)[:, :n_blocks])
    return xp.stack(out_words, axis=-1)  # [N, n_blocks, 4]


def encrypt_planes(rk_masks, planes, unroll: bool = False):
    """AES-256 encrypt bitsliced states.

    rk_masks: [15, 16, 8, N] uint32; planes: list of 8 arrays [16, N, G].
    Returns output planes (same layout).

    unroll=True (jax only) emits the 13 middle rounds as straight-line ops
    instead of a lax.fori_loop, whose round boundaries force every plane
    array through device memory.
    """
    return _encrypt_planes_core(rk_masks, planes, gn=False, unroll=unroll)


def _encrypt_planes_core(rk_masks, planes, gn: bool, unroll: bool = False):
    xp = _xp(planes[0])

    if gn:
        def ark(pl, r):
            return [pl[b] ^ rk_masks[r, :, b, None, :] for b in range(8)]
    else:
        def ark(pl, r):
            return [pl[b] ^ rk_masks[r, :, b, :, None] for b in range(8)]

    def round_fn(pl, r):
        pl = sbox_planes(pl)
        pl = _gather_pos(xp, pl, _SHIFTROWS_PERM)
        a1 = _gather_pos(xp, pl, _MIX_P1)
        a2 = _gather_pos(xp, pl, _MIX_P2)
        a3 = _gather_pos(xp, pl, _MIX_P3)
        xt_in = [pl[b] ^ a1[b] for b in range(8)]
        xt_out = _xt(xt_in)
        pl = [xt_out[b] ^ a1[b] ^ a2[b] ^ a3[b] for b in range(8)]
        return ark(pl, r)

    pl = ark(planes, 0)
    if xp is np or unroll:
        for r in range(1, 14):
            pl = round_fn(pl, r)
    else:
        import jax.lax as lax

        pl = lax.fori_loop(1, 14, lambda r, p: round_fn(p, r), pl)
    pl = sbox_planes(pl)
    pl = _gather_pos(xp, pl, _SHIFTROWS_PERM)
    pl = ark(pl, 14)
    return pl


def planes_to_words(planes, n_blocks: int):
    """Output planes -> keystream words [N, n_blocks, 4] uint32 (the 4
    little-endian u32 words of each 16-byte block)."""
    xp = _xp(planes[0])
    N = planes[0].shape[1]
    out_words = []
    for w in range(4):
        rows = []
        for i in range(32):
            p, b = 4 * w + i // 8, i % 8
            rows.append(planes[b][p])  # [N, G]
        cols = bit_transpose_32(rows)  # cols[j] bit i = rows[i] bit j
        stacked = xp.stack(cols, axis=-1)  # [N, G, 32]
        out_words.append(stacked.reshape(N, -1)[:, :n_blocks])
    return xp.stack(out_words, axis=-1)  # [N, n_blocks, 4]


def ctr_keystream_u64(keys_bytes, nonces, n_blocks: int, xp=np):
    """Full pipeline: [N, 32] uint8 keys + [N] python-int/uint64 nonces ->
    keystream u64 halves [N, 2*n_blocks, 2] uint32 (lo, hi), stream order.

    Host-side convenience wrapper; device pipelines call the pieces
    directly.
    """
    keys_bytes = np.asarray(keys_bytes, dtype=np.uint8)
    nonces = np.asarray(nonces, dtype=np.uint64)
    rk = expand_keys_bitsliced(keys_bytes)
    nlo = (nonces & np.uint64(0xFFFFFFFF)).astype(U32)
    nhi = (nonces >> np.uint64(32)).astype(U32)
    if xp is not np:
        rk = xp.asarray(rk)
        nlo = xp.asarray(nlo)
        nhi = xp.asarray(nhi)
    planes = counters_to_planes(nlo, nhi, n_blocks)
    out = encrypt_planes(rk, planes)
    words = planes_to_words(out, n_blocks)  # [N, B, 4]
    # u64 stream: block bytes as two LE u64s -> (w0, w1), (w2, w3)
    lo = words[:, :, 0::2]
    hi = words[:, :, 1::2]
    u64s = _xp(words).stack([lo, hi], axis=-1)  # [N, B, 2, 2]
    return u64s.reshape(words.shape[0], 2 * n_blocks, 2)
